"""The device timeline of a traced window, read from torch.profiler.

The window runs ``calls`` calls of the cell's entry between two marker
kernels (torch.cuda._sleep's) on every card the cell uses, with a few
traced calls on either side so that the window keeps clear of the trace's
edges. A card's device events between its own two markers are its window's:
on its one stream they run in launch order. Their names are reduced to
kernel stems ("void advect_kernel<float, ...>(...)" -> "advect_kernel");
memory copies and fills keep their kind, a copy between two cards
("Memcpy PtoP") too.

Over several cards each event keeps its card's index; busy time and idle
gaps are a card's, and the digest's busy time is the mean over its cards,
so that 1 - busy / window stays a card's average idle share. With one card
every reading is what it was before cards were counted.

Only the device is traced (with the CUDA runtime's calls, which come with
it), not PyTorch's host operators: the cells are partly bound by the host,
and recording every operator slowed a traced window by 1.5-2.3 times, which
read as idle time on the card. The idle gaps are named by the runtime call
the host was in, or else as host time outside the runtime.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    card: int = 0  # the CUDA device index of a device event


@dataclasses.dataclass
class Digest:
    """What the readers read: the window's device events and host events,
    its length, and the units (steps or ticks) it holds. ``extra["windows"]``
    holds each card's window (lo, hi) between its markers; ``window_us`` is
    the mean of the cards' windows."""

    window_us: float
    device: List[Event]
    host: List[Event]
    units: int
    unit: str                       # "step" or "tick"
    extra: Dict = dataclasses.field(default_factory=dict)

    @property
    def cards(self) -> List[int]:
        """The device indices of the cards in the window, in order."""
        return sorted(self.extra["windows"])

    def kernels(self) -> List[Event]:
        return [e for e in self.device if kind(e.name) == "kernel"]

    def _spans(self, card: int) -> List[Tuple[float, float]]:
        return sorted((e.start, e.start + e.dur) for e in self.device if e.card == card)

    def busy_us(self, card: Optional[int] = None) -> float:
        """Microseconds of ``card``'s window in which a kernel, copy or fill
        ran on it; without a card the mean over the cards."""
        if card is None:
            return sum(self.busy_us(c) for c in self.cards) / len(self.cards)
        busy, end = 0.0, None
        lo_w, hi_w = self.extra["windows"][card]
        for a, b in self._spans(card):
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

    def gaps(self, card: Optional[int] = None) -> List[Tuple[float, float]]:
        """``card``'s idle intervals in its window; without a card every
        card's, card by card."""
        if card is None:
            return [g for c in self.cards for g in self.gaps(c)]
        lo_w, hi_w = self.extra["windows"][card]
        out, t = [], lo_w
        for a, b in self._spans(card):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi_w > t:
            out.append((t, hi_w))
        return out


def stem(name: str) -> str:
    """A kernel's name without its return type, template and parameters."""
    n = name.strip().replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return re.split(r"[<(\s]", n, maxsplit=1)[0]


def kind(name: str) -> str:
    if name.startswith("Memcpy"):
        if "PtoP" in name:
            return "copy_ptop"          # between two cards
        return "copy_dtoh" if "DtoH" in name else "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def digest(events: List[Event], units: int, unit: str) -> Digest:
    """Each card's window between its two marker kernels. Raises unless
    every card with a device event recorded both."""
    windows = {}
    for c in sorted({e.card for e in events if e.device}):
        marks = sorted((e for e in events if e.device and e.card == c and MARKER in e.name),
                       key=lambda e: e.start)
        if len(marks) != 2:
            raise RuntimeError(f"traced window not found on card {c}: {len(marks)} marker "
                               f"kernels")
        windows[c] = (marks[0].start + marks[0].dur, marks[1].start)
    if not windows:
        raise RuntimeError("traced window not found: no marker kernels")
    device = [Event(stem(e.name) if kind(e.name) == "kernel" else e.name, True, e.start, e.dur,
                    e.card)
              for e in events if e.device and MARKER not in e.name
              and windows[e.card][0] <= e.start < windows[e.card][1]]
    lo, hi = min(w[0] for w in windows.values()), max(w[1] for w in windows.values())
    host = [e for e in events if not e.device and e.start < hi and e.start + e.dur > lo]
    window = sum(b - a for a, b in windows.values()) / len(windows)
    return Digest(window, device, host, units, unit, {"windows": windows})


def profile(call: Callable[[], None], calls: int, devices: Sequence) -> List[Event]:
    """Every device event, and the CUDA runtime's calls, of ``calls`` calls
    of ``call`` between two markers on each of the CUDA ``devices`` (a card
    named twice has one pair), with EDGE calls traced on either side."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    cards = sorted({torch.device(d).index for d in devices})

    def markers():
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda._sleep(1000)

    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(EDGE):
            call()
        markers()
        for _ in range(calls):
            call()
        markers()
        for _ in range(EDGE):
            call()
        for c in cards:
            torch.cuda.synchronize(c)
    return [Event(e.name, e.device_type == DeviceType.CUDA, float(e.time_range.start),
                  float(e.time_range.elapsed_us()),
                  e.device_index if e.device_type == DeviceType.CUDA else 0)
            for e in prof.events()]


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
    more than one call makes. Over several cards each name begins with its
    card ("cuda:1 advect_kernel")."""
    import bisect

    def named(card: int, name: str) -> str:
        return name if len(d.cards) == 1 else f"cuda:{card} {name}"

    ops: Dict[str, float] = {}
    for e in d.device:
        k = named(e.card, e.name)
        ops[k] = ops.get(k, 0.0) + e.dur
    host = sorted(d.host, key=lambda e: e.start)
    starts = [e.start for e in host]
    idle: Dict[str, float] = {}
    for card in d.cards:
        for a, b in d.gaps(card):
            t = 0.5 * (a + b)
            j = k = bisect.bisect_right(starts, t) - 1
            while j >= 0 and k - j < SCAN and host[j].start + host[j].dur < t:
                j -= 1
            inside = j >= 0 and host[j].start + host[j].dur >= t
            name = named(card, host[j].name if inside else OUTSIDE)
            idle[name] = idle.get(name, 0.0) + (b - a)

    def ranked(x):
        return [[k[:120], v * 1e-6] for k, v in sorted(x.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
