"""Spans inside the port: named, nested intervals on the host clock, each
with the port's kernel launches made inside it.

    from tpufluid_torch import spans

    spans.enable(capacity=1 << 16)     # or ring=True: keep the newest
    state = step(state, dt, splats)    # any calls of the step, frame, tick
    got = spans.take()                 # the finished spans, oldest first
    spans.disable()

The step, the frame, the fleet's tick and the servers open spans at their
pass boundaries (``with spans.span("sunrays"): ...``). A span records

- its name;
- its start and end, ``time.perf_counter_ns``;
- its id, its parent's id (the enclosing open span on the same thread, 0
  for none) and its root's id (the outermost span it belongs to, so all
  spans of one call share it);
- its thread (``threading.get_ident``);
- the launches of ``build.Kernel`` made inside it and not inside a child
  span: the kernels' own launch counts, read at the span's edges;
- the bytes that the sharded step's halo exchanges sent between shards
  inside it and not inside a child span, read from
  ``parallel.halo.SENT`` at its edges in the same way.

A span is kept when it ends, so children come before their parent. The
recorder keeps spans in a buffer of fixed capacity, allocated by
``enable``. A full buffer drops the newer spans and counts them
(``dropped``), or, with ``ring=True``, overwrites the oldest.

Launches are counted across the process: a span counts a kernel launched
by another thread while it is open. Every caller in the port launches its
kernels from the thread that opens its spans.

While the recorder is off, ``span`` returns one shared object whose enter
and exit do nothing: no allocation, no clock read. ``enable(profiler=True)``
also opens a ``torch.profiler.record_function`` range for each span, so a
profiler's trace carries the spans on its own clock (``app.py --profile``).
"""

from __future__ import annotations

import threading
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional

from tpufluid_torch.ops.cuda.build import KERNELS


class Span(NamedTuple):
    id: int
    parent: int
    root: int
    thread: int
    name: str
    start_ns: int
    end_ns: int
    launches: int
    bytes: int = 0


def launches() -> int:
    """Every build.Kernel's launches so far."""
    return sum(k.launches for k in KERNELS.values())


# The counter of the bytes sent between shards (parallel/halo.py's SENT,
# which registers itself here when it is imported: the halo imports this
# module, not the other way round).
_sent = None


def count_sent(counter) -> None:
    """Read ``counter.bytes`` at every span's edges from now on."""
    global _sent
    _sent = counter


def sent() -> int:
    """The bytes sent between shards so far (0 before the halo is loaded)."""
    return _sent.bytes if _sent is not None else 0


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """Finished spans in a buffer of ``capacity``; see the module's doc."""

    def __init__(self, capacity: int, ring: bool = False, profiler: bool = False):
        if capacity < 1:
            raise ValueError(f"a recorder holds at least one span, got capacity {capacity}")
        self.capacity = capacity
        self.ring = ring
        self.profiler = profiler
        self.dropped = 0
        self._buf: List[Optional[Span]] = [None] * capacity
        self._n = 0                  # spans written since the last take
        self._next_id = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        """The open spans of the calling thread, outermost first."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def put(self, s: Span) -> None:
        with self._lock:
            if self._n >= self.capacity and not self.ring:
                self.dropped += 1
                return
            self._buf[self._n % self.capacity] = s
            self._n += 1

    def _kept(self) -> List[Span]:
        n, cap = self._n, self.capacity
        if n <= cap:
            return self._buf[:n]
        k = n % cap
        return self._buf[k:] + self._buf[:k]

    def take(self) -> List[Span]:
        """The spans kept since the last take, oldest first; empties the
        buffer (the dropped count stays)."""
        with self._lock:
            out = self._kept()
            self._n = 0
        return out

    def snapshot(self) -> List[Span]:
        """The kept spans, oldest first, leaving the buffer as it is."""
        with self._lock:
            return self._kept()


class _Open:
    """A span being recorded."""

    __slots__ = ("rec", "name", "id", "parent", "root", "start", "at", "child", "rf",
                 "sent_at", "child_sent")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        up = stack[-1] if stack else None
        self.id = rec.new_id()
        self.parent = up.id if up is not None else 0
        self.root = up.root if up is not None else self.id
        self.child = 0
        self.child_sent = 0
        stack.append(self)
        self.rf = None
        if rec.profiler:
            from torch.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.at = launches()
        self.sent_at = sent()
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        inside = launches() - self.at
        moved = sent() - self.sent_at
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        stack = rec.stack()
        stack.pop()
        if stack:
            stack[-1].child += inside
            stack[-1].child_sent += moved
        rec.put(Span(self.id, self.parent, self.root, threading.get_ident(), self.name,
                     self.start, end, inside - self.child, moved - self.child_sent))
        return False


_recorder: Optional[Recorder] = None


def span(name: str):
    """A context manager that records the span ``name`` while the recorder
    is on, and does nothing while it is off."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Open(rec, name)


def enable(capacity: int = 1 << 16, ring: bool = False, profiler: bool = False) -> Recorder:
    """Turn the recorder on with an empty buffer of ``capacity`` spans and
    return it. ``ring``: overwrite the oldest span when full, rather than
    dropping the newest. ``profiler``: also open a profiler range a span."""
    global _recorder
    _recorder = Recorder(capacity, ring, profiler)
    return _recorder


def disable() -> Optional[Recorder]:
    """Turn the recorder off; returns it (its spans can still be taken)."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


def recorder() -> Optional[Recorder]:
    """The recorder while it is on, else None."""
    return _recorder


def take() -> List[Span]:
    """The current recorder's spans (see Recorder.take); [] while off."""
    rec = _recorder
    return rec.take() if rec is not None else []


def dropped() -> int:
    """Spans the current recorder dropped because its buffer was full."""
    rec = _recorder
    return rec.dropped if rec is not None else 0


def summary(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """Each span name's count and its p50 and p95 duration in ms (the
    nearest-rank percentiles)."""
    by: Dict[str, List[int]] = {}
    for s in spans:
        by.setdefault(s.name, []).append(s.end_ns - s.start_ns)
    out = {}
    for name, d in sorted(by.items()):
        d.sort()
        n = len(d)
        out[name] = {"count": n, "p50_ms": d[(50 * n - 1) // 100] * 1e-6,
                     "p95_ms": d[(95 * n - 1) // 100] * 1e-6}
    return out
